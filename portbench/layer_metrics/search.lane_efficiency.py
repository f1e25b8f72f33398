"""search.lane_efficiency: the share of launched lane slots that expanded a
vertex, ``work / launched`` of ``search_tiled(with_stats=True)`` summed over
every call of the traced window (``work``: lane iterations expanded;
``launched``: iterations executed x lanes launched)."""


def read(t):
    launched = t.stats.get("launched", 0)
    return t.stats["work"] / launched if launched else None

"""Multi-rank layer of the port (port of ``repro.distributed``): logical-axis
rules (:mod:`sharding`), the collectives the sharded paths use
(:mod:`comm`), the mesh-aware index (:mod:`ann`) and fault tolerance
(:mod:`fault`)."""

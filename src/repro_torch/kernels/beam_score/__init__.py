from repro_torch.kernels.beam_score.ops import beam_score
from repro_torch.kernels.beam_score.ref import beam_score_ref, score_block

__all__ = ["beam_score", "beam_score_ref", "score_block"]

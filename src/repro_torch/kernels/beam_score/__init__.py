from repro_torch.kernels.beam_score.ops import beam_score, beam_score_int8, beam_score_pq
from repro_torch.kernels.beam_score.ref import (
    beam_score_int8_ref,
    beam_score_pq_ref,
    beam_score_ref,
    score_block,
)

__all__ = ["beam_score", "beam_score_int8", "beam_score_pq", "beam_score_ref",
           "beam_score_int8_ref", "beam_score_pq_ref", "score_block"]

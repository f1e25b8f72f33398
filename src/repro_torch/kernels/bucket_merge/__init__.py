from repro_torch.kernels.bucket_merge.ops import bucket_merge, kernel_takes
from repro_torch.kernels.bucket_merge.ref import bucket_merge_ref

__all__ = ["bucket_merge", "bucket_merge_ref", "kernel_takes"]

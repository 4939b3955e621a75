"""Context extraction, masking, gathers and their scatter-add backward,
SpMM, the fused lookup, the fused PE+attention kernels and the per-link
attention kernels."""
from lpformer_tpu_torch.ops.attention import fused_link_attention  # noqa: F401

"""Context extraction, masking, gathers and their scatter-add backward,
SpMM and the fused PE+attention kernels."""

"""GF(2^w) arithmetic, coding matrices, and the region engines: plain
torch (``gf_torch``) and the Hopper kernels (``gf_cuda``)."""

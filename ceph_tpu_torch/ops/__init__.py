"""GF(2^w) arithmetic, coding matrices, the region engines and CRUSH's
batched primitives: plain torch (``gf_torch``, ``crush_torch``) and the
Hopper kernels (``gf_cuda``, ``crush_cuda``)."""

"""The plain reference that decides ``correct``: plain PyTorch (float32
sums, TF32 off), written from the published descriptions (CLIP ViT-L/14, the
NeRF field and its volume rendering, Adam), importing nothing of the port
and nothing of JAX. It takes only what the benchmark made (weights, scans,
poses, token ids, the seed) and works out again whatever the port derives
from them: the background view, each pose's rays, each training step's
draws.

Every product and every activation the configurations' numerics round goes
through a ``Precision``: ``REFERENCE`` computes in the bfloat16 they state,
``CONTROL`` the same in float8 e4m3 (one scale a tensor), the precision
below it.
"""

"""train.hash_encode_ns_per_point: the hash encoding's device nanoseconds a
point: H1's forward and backward kernels (csrc/hashgrid.cu: hash_fwd,
hash_bwd, by name) in the traced window over the points the steps sent
through the encoding (the ``train.encoded_points`` counter of
nerf/trainer.py). Nothing is read without the kernel or the counter."""

from benchmark.metrics import _hashgrid


def read(ctx: dict):
    got = _hashgrid.encode_window(ctx)
    if got is None:
        return None
    seconds, _, points = got
    return seconds * 1e9 / points

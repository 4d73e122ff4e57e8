"""score.hash_march_ns_per_sample: H2's device nanoseconds a needed sample:
the crop march's kernel (csrc/hash_march.cu: hash_march, by name) in the
traced window over the samples its rays need, counted by ``_hash_march``
(the reference's march of the first traced clip group, scaled by the
window's clip groups). Nothing is read without the kernel (the plain
render)."""

from benchmark.metrics import _hash_march


def read(ctx: dict):
    got, n = _hash_march.kernel_window(ctx), _hash_march.samples(ctx)
    if got is None or not n:
        return None
    return got[0] * 1e9 / n

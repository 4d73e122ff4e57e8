"""score.hash_march_roofline: H2 (hash_march) over the traced window as a
share of its bound, max(bytes / 3.35 TB/s, operations / 989 TFLOP/s), the
operations and bytes of the window's needed samples and live rays as
``_hash_march`` counts them (the corner reads left out)."""

from benchmark import roofline
from benchmark.metrics import _hash_march


def read(ctx: dict):
    got, n, field = _hash_march.kernel_window(ctx), _hash_march.samples(ctx), ctx.get("field")
    if got is None or not n or not field or not ctx.get("hash_live"):
        return None
    seconds, launches = got
    live = ctx["hash_live"] * _hash_march.groups(ctx)
    bound, _ = roofline.bound_ms(*_hash_march.flops_bytes(field, n, live, launches))
    return 100.0 * bound / (seconds * 1e3)

"""train.hash_encode_roofline: H1 (hash_fwd and hash_bwd) as a share of its
bound over the traced window: max(bytes / 3.35 TB/s, operations / 989
TFLOP/s) of the points the steps encoded (``train.encoded_points``) and
those whose gradient reached the table (the samples the loss uses and the
free-space samples), counted as ``_hashgrid`` counts them, over the kernels'
device time."""

from benchmark import roofline
from benchmark.metrics import _hashgrid


def read(ctx: dict):
    got = _hashgrid.encode_window(ctx)
    if got is None:
        return None
    seconds, bwd_launches, points = got
    field = ctx["field"]
    bwd_points = ctx["steps"] * _hashgrid.backward_points(ctx)
    nbytes = ((points + bwd_points) * _hashgrid.point_bytes(field)
              + bwd_launches * _hashgrid.table_bytes(field))
    flops = (points + bwd_points) * _hashgrid.interp_flops(field)
    bound_ms, _ = roofline.bound_ms(flops, nbytes)
    return 100.0 * bound_ms / (seconds * 1e3)

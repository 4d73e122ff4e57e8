"""train.kernel_ms_per_step: device milliseconds a training step in the
training kernels (csrc/train.cu: K5 density_rows, K6 / K7 train_rows, K7's
dw_gemm and reduce_grads), from the traced window's kernels by name."""

KERNELS = ("density_rows", "train_rows", "dw_gemm", "reduce_grads")


def read(ctx: dict):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("steps"):
        return None
    seconds, launches = trace.time_of(*KERNELS)
    if launches == 0:
        return None
    return seconds * 1e3 / ctx["steps"]

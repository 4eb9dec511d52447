"""step_ops.step [ops/step]: device operations (kernels, copies, fills)
per step of the traced window, from the device trace."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["calls"]:
        return None
    return len(ctx.trace["dev"]) / ctx.trace["calls"]

"""gnn_round_roofline: the GNN round's share of its roofline, in %.

The least time the card could take for the traced calls' rounds, the
larger of their operations over the fp16 tensor cores' peak and their
bytes over the HBM's (the system's `work`: the product 2 (rows + 1) F^2
a window and F a valid edge; the slab read and written once a call, the
edges in, the summaries out), over the device time of the round's
kernels by name in the trace, with the memsets of the traced calls
added. Nothing where the trace holds none of the round's kernels."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.peaks:
        return None
    kernel_us = tr.device_time_us(ctx.round_kernels)
    if kernel_us <= 0:
        return None
    busy_s = (kernel_us + tr.device_time_us(cats=("gpu_memset",))) * 1e-6
    calls = ctx.window.traced_calls
    outs = [ctx.system.outputs[k] for k in calls]
    windows = sum(len(o) for o in outs)
    valid = sum(int(o[:, 3].sum()) for o in outs)
    ops, nbytes = ctx.system.work(windows, len(calls), valid)
    least = max(ops / ctx.peaks["fp16_tensor_flops"],
                nbytes / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * least / busy_s

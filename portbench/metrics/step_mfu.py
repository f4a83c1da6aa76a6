"""step_mfu: the whole step's share of the card's fp16 tensor-core
peak, in %: the operations of the window's calls (the system's `work`)
over their seconds on the host's clock around `process()`. It bounds
what any kernel of the step can claim, whatever runs it."""


def read(ctx):
    win = ctx.window
    seconds = sum(win.call_s)
    if not ctx.peaks or not win.timed_calls or seconds <= 0:
        return None
    outs = [ctx.system.outputs[k] for k in win.timed_calls]
    valid = sum(int(o[:, 3].sum()) for o in outs)
    ops, _ = ctx.system.work(win.windows, len(outs), valid)
    return 100.0 * ops / (seconds * ctx.peaks["fp16_tensor_flops"])

"""The share of the traced generation calls' time in which no operation ran
on the device: 100 x (1 - the union of the device operations' intervals /
the host time from the first traced call to the synchronize after the
last), both from the session that records device activity alone. The
driver's own idle share reads the same two numbers (`busy_s`, `window_s`)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.fallback or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

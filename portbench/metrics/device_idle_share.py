"""device_idle_share: the share of the traced window in which no kernel,
copy or memset ran on the card, in %."""


def read(ctx):
    t = ctx["totals"]
    if t.window_s <= 0 or t.device_events == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

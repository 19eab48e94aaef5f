"""Layer device: the share of the device-only traced segment in which
nothing ran on the card, 1 - busy union / that segment's wall (the
`busy_s` and `window_s` of the result's `device`). The CUDA-only
profiler still records the runtime calls, so its wall, and this share,
run somewhat above an untraced segment's."""

UNIT = "%"


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)

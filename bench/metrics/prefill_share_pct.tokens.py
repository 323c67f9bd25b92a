"""Share of the rounds' wall time outside the fused decode steps
(prefills, admissions and retirements), percent:
1 - decode_s / wall_s of `inflight_serve`'s returns."""


def read(ctx):
    e = ctx.entry
    if not e.get("wall_s"):
        return None
    return 100.0 * (1.0 - e["decode_s"] / e["wall_s"])

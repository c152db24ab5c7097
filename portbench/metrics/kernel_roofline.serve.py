"""The kernels the serving window launches (the norm-chain forward, four
launches at every decode) in the traced half: the least time of each
decode at its bucket (bytes over the card's bandwidth), summed over the
traced reconstruct calls and scaled to the launches the trace holds, over
their device time in the trace."""


def read(run):
    s = run.trace_summary
    calls = [c for c in run.host.get("traced_calls", ())
             if c[0] == "reconstruct"]
    if s is None or not calls:
        return None
    launches, seconds = s["kernels"].get("norm_chain_fwd", (0, 0.0))
    if not launches or seconds <= 0:
        return None
    bounds = run.host["decode_bounds"]
    per_call = sum(bounds[c[2]] for c in calls) / len(calls)
    return 100.0 * per_call * (launches / 4.0) / seconds

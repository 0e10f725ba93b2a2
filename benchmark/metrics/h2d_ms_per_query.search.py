"""Device time of host-to-device copies in the traced window over the
queries answered (device trace)."""


def read(run):
    tr = run.trace_summary
    done = run.done()
    if tr is None or not done:
        return None
    ms = 1e3 * tr.device_s(lambda name: name.startswith("Memcpy HtoD"))
    return ms / len(done) if ms > 0 else None

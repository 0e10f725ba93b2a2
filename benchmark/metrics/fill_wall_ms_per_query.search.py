"""The search's batched fills, each timed by the program's counters from
its call to the card's synchronisation (``observability.counters``,
engines ``cuda/...``), over the queries answered."""


def read(run):
    done = run.done()
    secs = sum(v["seconds"] for k, v in run.counters.items() if k.startswith("cuda"))
    if not done or secs <= 0:
        return None
    return 1e3 * secs / len(done)

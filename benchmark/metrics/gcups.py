"""Database search: each answered query's length times the database's
residues, summed, over the window's time, from its start to the last
answer (host clock)."""


def read(run):
    done = run.done()
    if not done or run.window_s <= 0:
        return None
    cells = sum(r["cells"] for r in done)
    return cells / run.window_s / 1e9

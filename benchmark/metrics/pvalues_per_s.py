"""p-values answered over the window's time, from its start to the last
answer (host clock)."""


def read(run):
    done = run.done()
    if not done or run.window_s <= 0:
        return None
    return len(done) / run.window_s

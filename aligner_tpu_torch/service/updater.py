"""Updater — batch promotion pass (aligner-web/src/bin/updater.rs).

For every unfinished task: if its progress is 100%, promote the best
subtask into result_matrices and delete the subtasks (idempotent; the
progress SSE handler performs the same promotion inline)."""

from __future__ import annotations

from .store import Store, open_store


def run_once(store: Store | None = None) -> int:
    """One pass; returns the number of promoted tasks (updater.rs:12-29)."""
    store = store or open_store()
    promoted = 0
    for hash_ in store.get_all_unfinished_hashes():
        if store.promote_if_complete(hash_):
            promoted += 1
    return promoted


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="aligner-torch-updater", description=__doc__)
    ap.parse_args(argv)
    print(f"promoted {run_once()} task(s)")
    return 0


if __name__ == "__main__":
    main()

"""``aligner-repeat-search`` — latent dispersed-repeat discovery.

Counterpart of ``aligner_tpu/cli/repeat_search.py`` (itself the
equivalent of aligner-core/src/bin/latent-repeat-search, args.rs:5-44,
main.rs:20-73, cmd/mod.rs:90-98): no ``--input`` → testing mode;
``--input`` + ``--csv`` → csv (masked) mode; ``--input`` → exploring
mode.  Writes ``output.csv`` (name, z_value, left_coord, right_coord) and
``matrices.json`` in the reference's serde-ndarray format
(``{"v":1,"dim":[r,c],"data":[...]}``).

``--device cuda`` runs the window scan and the survivor realignment on
the fill kernel's PWM specialisation, ``--device cpu`` on its plain
PyTorch version; the default is cuda, and without a card it raises.

Divergences: ``--seed`` provides reproducibility (the reference uses an
unseeded thread_rng).  The writability pre-flight of the output paths
leaves no file behind: a path it had to create is removed again at once,
so a run that aborts (bad input, interrupted scan) does not leave empty
``output.csv``/``matrices.json`` files, as the JAX package's CLI does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..io.records import Record, write_records
from ..observability import configure_logging
from ..repeat.engine import (
    SearchOptions,
    run_csv_cmd,
    run_exploring_cmd,
    run_testing_cmd,
)
from ..service.models import matrix_to_serde_dict


def check_writable(path: str) -> None:
    """Raise OSError unless ``path`` can be opened for writing; a file
    this check creates is removed again."""
    existed = os.path.exists(path)
    with open(path, "a"):
        pass
    if not existed:
        os.unlink(path)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="aligner-repeat-search", description=__doc__.splitlines()[0]
    )
    ap.add_argument("-i", "--input", default=None)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--csv", default=None)
    ap.add_argument("-d", "--deletions", type=float, default=30.0)
    ap.add_argument("-e", "--extension", type=float, default=7.0)
    ap.add_argument("--rsquared", type=float, default=100_000.0)
    ap.add_argument("--kd", type=float, default=0.0)
    ap.add_argument("-q", "--query-offset", type=int, default=30)
    ap.add_argument("-r", "--repeat-length", type=int, default=300)
    ap.add_argument("--threads", type=int, default=1,
                    help="window-enumeration interleave factor (kept for "
                         "window-set parity; compute is batched on device)")
    ap.add_argument("--simple-init", action="store_true")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--reverse", action="store_true")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="JSON file updated per cycle; resumes if present")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="cuda: the kernels (raises without a card); "
                         "cpu: their plain PyTorch versions")
    args = ap.parse_args(argv)
    configure_logging()

    opts = SearchOptions(
        repeat_length=args.repeat_length,
        query_offset=args.query_offset,
        deletions=args.deletions,
        extension=args.extension,
        rsquared=args.rsquared,
        kd=args.kd,
        threads=args.threads,
        repeats=args.repeats,
        simple_init=args.simple_init,
        reverse=args.reverse,
        device=args.device,
    )
    rng = np.random.default_rng(args.seed)

    output_path = args.output or os.path.join(os.getcwd(), "output.csv")
    matrices_path = (
        f"{args.output}.matrices.json"
        if args.output
        else os.path.join(os.getcwd(), "matrices.json")
    )
    # pre-flight the output paths BEFORE a potentially hours-long scan:
    # an unwritable --output must fail here, not after the compute
    for p in (output_path, matrices_path):
        try:
            check_writable(p)
        except OSError as e:
            ap.error(f"cannot write {p}: {e}")

    if args.input is None:
        if args.csv is not None:
            ap.error("--csv requires --input (csv mode masks known "
                     "repeats out of the input FASTA, cmd/mod.rs:90-98)")
        result = run_testing_cmd(opts, rng)
    elif args.csv is not None:
        result = run_csv_cmd(opts, args.input, args.csv, rng,
                             checkpoint=args.checkpoint)
    else:
        result = run_exploring_cmd(opts, args.input, rng,
                                   checkpoint=args.checkpoint)

    records = []
    matrices = {}
    for key, value in result.items():
        for task in value.tasks:
            records.append(
                Record(
                    name=key, z_value=task.z,
                    left_coord=task.left_coord, right_coord=task.right_coord,
                )
            )
        # serde's ndarray layout, as the reference writes it (main.rs:60-64)
        matrices[key] = matrix_to_serde_dict(value.matrix)

    write_records(output_path, records)
    with open(matrices_path, "w") as fh:
        json.dump(matrices, fh)

    print(
        f"\nOutput written to:\n 1. Result: {output_path}\n 2. Matrices: {matrices_path}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

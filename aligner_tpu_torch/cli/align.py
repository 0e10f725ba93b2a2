"""``aligner-align`` — pairwise-align two FASTA records.

Equivalent of aligner-core/src/bin/aligner-cli (main.rs, args.rs): reads a
FASTA with exactly two records, aligns them over the Protein alphabet
with the embedded BLOSUM62, default del=11 ext=2, ``--global`` switches
from local to global.  The default output is byte-identical to the
reference's ``println!("{:?}", …get_alignment(blosum62))`` (main.rs:53) —
the Rust Debug rendering of the match-string enum vector, e.g.
``[A, W, Blank, H, E]``; ``--pretty`` renders the gapped query/match/
target lines plus score and coords instead.  Like the reference, the
result also goes to ``--output`` when given (the reference accepts the
flag but ignores it — divergence kept useful on purpose).

Counterpart of ``aligner_tpu/cli/align.py`` with the same stdout.
``--device cuda`` (the default; raises without a card) runs the CUDA
kernels: a global pair on the row-scan fill and the replay walk, a local
pair on the batched fill and walk.  ``--device cpu`` runs their plain
PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys

from ..align import align_global, align_local
from ..alphabet import BLANK, POS, DNA, Protein
from ..errors import ValidationError
from ..io import read_fasta_file
from ..observability import configure_logging
from ..result import Alignment


def reference_debug_format(alignment: Alignment, matrix) -> str:
    """The reference CLI's exact stdout: Rust ``{:?}`` of the
    ``Vec<Protein>``/``Vec<DNA>`` match string — the enum variant names
    are exactly the alphabet letters (enums.rs:55-146),
    ``[A, W, Blank, Pos]`` style."""
    names = alignment.alphabet.letters

    def name(code: int) -> str:
        if code == BLANK:
            return "Blank"
        if code == POS:
            return "Pos"
        if 0 <= code < len(names):
            return names[code]
        return "Any"

    codes = alignment.match_string(matrix)
    return "[" + ", ".join(name(int(c)) for c in codes) + "]"


def render_result(alignment: Alignment, matrix) -> str:
    q, t = alignment.render()
    match = alignment.alphabet.decode(alignment.match_string(matrix))
    lines = [
        f"query : {q}",
        f"match : {match}",
        f"target: {t}",
        f"score : {alignment.f}",
        f"coords: query {alignment.coords[0]}, target {alignment.coords[1]}",
    ]
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="aligner-align", description=__doc__.splitlines()[0]
    )
    ap.add_argument("-i", "--input", required=True, help="FASTA with 2 records")
    ap.add_argument("-d", "--deletions", type=float, default=11.0)
    ap.add_argument("-e", "--extension", type=float, default=2.0)
    ap.add_argument("-g", "--global", dest="global_", action="store_true")
    ap.add_argument("-m", "--matrix", default="blosum62",
                    help="blosum62 | blosum50 | path to a matrix file "
                         "(the reference CLI hardcodes blosum62)")
    ap.add_argument("--dna", action="store_true", help="DNA alphabet")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument(
        "--pretty", action="store_true",
        help="human-readable rendering instead of the reference's "
             "debug-format line",
    )
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="cuda: the kernels (raises without a card); "
                         "cpu: their plain PyTorch versions")
    args = ap.parse_args(argv)
    configure_logging()

    seqs = read_fasta_file(args.input)
    if len(seqs) != 2:
        raise ValidationError(f"There's should be 2 sequences, not {len(seqs)}")

    from .search import load_matrix

    if args.dna and args.matrix in ("blosum62", "blosum50"):
        raise ValidationError(
            "--dna needs a 4x4 matrix file (-m PATH): DNA codes would "
            "silently index the first 4 rows of a protein matrix"
        )
    m = load_matrix(args.matrix)
    alpha = DNA if args.dna else Protein
    # same trap via a FILE as the builtin-name guard above: a
    # wrong-sized matrix must not silently score the wrong submatrix
    # (DNA codes against a protein matrix's first 4 rows) or crash deep
    # in an engine (protein codes off the end of a 4x4)
    if m.shape[0] < alpha.volume() or (args.dna and m.shape[0] != 4):
        raise ValidationError(
            f"matrix is {m.shape[0]}x{m.shape[1]} but "
            f"{'DNA needs exactly 4' if args.dna else f'the protein alphabet needs >= {alpha.volume()}'}"
            " rows"
        )
    fn = align_global if args.global_ else align_local
    result = fn(
        seqs[0].seq.decode(), seqs[1].seq.decode(), m,
        args.deletions, args.extension, device=args.device,
        alphabet=DNA if args.dna else Protein,
    )
    if args.pretty:
        out = render_result(result.alignment, m)
    else:
        out = reference_debug_format(result.alignment, m)
    print(out)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

from .fasta import FastaRecord, read_fasta, read_fasta_file, write_fasta
from .matrix_io import matrix_from_csv, matrix_to_csv
from .records import Record, read_records, write_records

__all__ = [
    "FastaRecord",
    "read_fasta",
    "read_fasta_file",
    "write_fasta",
    "matrix_from_csv",
    "matrix_to_csv",
    "Record",
    "read_records",
    "write_records",
]

"""Latent-repeat search: windowed PWM scans with iterative matrix refinement.

Counterpart of ``aligner_tpu.repeat``: the window scan is batched
scores-only launches of the fill kernel's PWM specialisation (all windows
of a chunk in one launch), with full alignments computed only for the
z-filtered survivors.
"""

from .engine import (
    SearchOptions,
    Task,
    TaskResult,
    calculate_cycle,
    calculate_starting_values,
    filter_tasks,
    generate_descendants,
    mutate,
    perform_calculation_per_sequence,
    run_csv_cmd,
    run_exploring_cmd,
    run_testing_cmd,
    windows_of,
)

__all__ = [
    "SearchOptions",
    "Task",
    "TaskResult",
    "windows_of",
    "calculate_starting_values",
    "calculate_cycle",
    "filter_tasks",
    "generate_descendants",
    "mutate",
    "perform_calculation_per_sequence",
    "run_testing_cmd",
    "run_exploring_cmd",
    "run_csv_cmd",
]

"""The alignment service's framework-free layer.

Only the data models are ported so far (``models.py``, a copy of
``aligner_tpu/service/models.py``): their serde matrix codec writes the
repeat search's ``matrices.json`` and its engine checkpoints.
"""

"""Paths of the port that cut one problem into parts: the column-blocked
pipeline for one huge global pair (``wavefront_sp``), on one card.  Placing
the parts on several cards (``torch.distributed``) comes later."""

from .wavefront_sp import sharded_global_align, sharded_global_end_score

__all__ = ["sharded_global_align", "sharded_global_end_score"]

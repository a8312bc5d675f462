"""Validation and trajectory visualization (counterpart of
``mvldm_tpu/visualization/``): numpy and Pillow, and torch for
:mod:`.drawing`."""

from .layout import add_border, hcat, vcat
from .annotation import add_label

__all__ = ["add_border", "add_label", "hcat", "vcat"]

"""Data pipeline: RE10K chunks, view samplers, shims, datasets and the loader."""

"""Synthetic token stream for training (``data/pipeline.py``)."""

"""Collective-ops backends over PE-stacked tensors (``comms/api.py``)."""

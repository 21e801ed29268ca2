"""Multi-carrier scans: the batched band scan (``carriers.py``)."""

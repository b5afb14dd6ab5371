"""Model configurations of the LM serving slice (``configs/base.py``)."""

"""The entries a traffic mix drives, one module each (`harness.py`)."""

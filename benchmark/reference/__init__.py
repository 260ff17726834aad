"""The plain float32 reference that decides ``correct``: the two
recognizers (``models.py``) and the grammar rules (``manager.py``). It
imports nothing of the program under test."""

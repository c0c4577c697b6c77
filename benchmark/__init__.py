"""The port's benchmark: ``python3 -m benchmark.run`` (see ``run.py``)."""

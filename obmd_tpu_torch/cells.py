"""Cell-grid constants shared with `obmd_tpu/cells.py`."""

# Sentinel coordinate for empty slots: large but finite, so padded-vs-real
# displacements stay finite and drop out of every cutoff test.
BIG = 1.0e8

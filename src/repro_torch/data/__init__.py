"""Synthetic corpora and mutation streams, numpy only, so that the port and
the reference can be fed byte-identical data."""

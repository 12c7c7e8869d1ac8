"""Launchers: ``serve.py`` (a serving engine over a synthetic corpus)."""

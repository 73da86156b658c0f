"""Hypervector encoders and conventional-HDC math (port of ``repro.hdc``)."""

"""Winograd/Toom-Cook math: exact matrix construction and quantization
settings (numpy constants, no device work)."""

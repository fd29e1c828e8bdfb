"""Core: nibble decomposition, quantization and the QuantLinear layer."""

"""Model code of the port: norms, rope, MLPs, attention, the decoder stack."""

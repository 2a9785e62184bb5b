"""LM substrate: layers, attention, SSM, MoE and the model assembly."""

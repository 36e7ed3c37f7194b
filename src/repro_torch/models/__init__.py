"""Model stack for the port: layers, attention, MoE and the assembler."""

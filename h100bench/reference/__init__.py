"""The plain reference of the benchmark: a frozen copy of the port's
plain PyTorch path (f32, the bf16 V-cycle the configuration states),
importing nothing of the port."""

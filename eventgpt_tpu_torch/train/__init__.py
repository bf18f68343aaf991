"""Training-side pieces of the port; only the LoRA merge so far."""

"""The plain reference: seeded weights, quantization arithmetic, the
float32 forward pass and the served-token comparison. Plain PyTorch; it
imports nothing of the program."""

"""The plain reference: the configuration's model, its loss and AdamW in
plain PyTorch, float32 with TF32 off. It imports nothing of the program
and takes no tensor the program made: weights and inputs come from the
benchmark's seed, and the program's outputs only reach it to be judged."""

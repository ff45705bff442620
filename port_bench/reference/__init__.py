"""The plain reference that decides ``correct``: plain PyTorch, float32 with
TF32 off, written from the published architectures and the served
pipeline's definition.  It imports nothing of the port, of JAX or of the
JAX package, and takes nothing the port made: it is handed the seeded
weights and images and works out the rest again."""

"""The benchmark's plain reference: sjpeg's baseline encoder in NumPy,
independent of the code under test (it imports neither the JAX package nor
the PyTorch port).  `encoder.encode_images` is the entry."""

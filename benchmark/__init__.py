"""The benchmark of the PyTorch/CUDA port (sjpeg_tpu_torch): one cell a
run, driven by the files under configs/, traffic/, metrics/ and kernels/."""

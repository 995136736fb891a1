"""The benchmark of dcnet_tpu_torch on the NVIDIA H100: `python3 -m portbench.run`."""

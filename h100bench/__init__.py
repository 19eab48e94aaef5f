"""The H100 benchmark of the PyTorch/CUDA port (openfoam_tpp_tpu_torch):
`python3 h100bench/run.py --workload CELL --seed N --seconds S --trace 0|1`."""

"""The benchmark of the PyTorch and CUDA port (``judo_tpu_torch``) on NVIDIA
GPUs. ``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; README.md sets out the layout."""

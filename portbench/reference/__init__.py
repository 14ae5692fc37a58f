"""The plain reference that decides ``correct``: plain PyTorch that works a
cell's plans out again from the same inputs. It imports nothing of the port
(``judo_tpu_torch``), of the JAX package (``judo_tpu``) or of JAX, and reads
the task snapshots and the policy weights as data files."""

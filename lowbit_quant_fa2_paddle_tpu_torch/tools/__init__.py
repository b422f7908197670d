"""Command-line tools of the port: ``autotune`` (the launch-plan tuner that
fills ``utils/tuning.py``'s cache) and ``llm_accuracy_eval`` (the
cache-accuracy ladder). Run each as ``python -m
lowbit_quant_fa2_paddle_tpu_torch.tools.<name>``."""

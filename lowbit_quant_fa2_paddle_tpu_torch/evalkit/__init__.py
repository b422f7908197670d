"""Eval/inference kit — the reference's ``inferenceKit`` side tree
(src/triton/utils/inferenceKit/: dataset loaders, answer grader, batched
inference with resume, layered config). The PyTorch port's own copy of
``lowbit_quant_fa2_paddle_tpu/evalkit/`` (numpy and the standard library;
sympy optional), so that importing it loads nothing of the JAX package."""

from lowbit_quant_fa2_paddle_tpu_torch.evalkit.config import InferenceConfig
from lowbit_quant_fa2_paddle_tpu_torch.evalkit.datasets import DATASETS, load_dataset
from lowbit_quant_fa2_paddle_tpu_torch.evalkit.grader import extract_answer, grade_numeric
from lowbit_quant_fa2_paddle_tpu_torch.evalkit.inference import run_inference

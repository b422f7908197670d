"""Build for the native host extension (role of the reference's setup.py
CUDAExtension build, setup.py:27-144 — here a plain C++ CPython extension;
the device kernels are Pallas and need no build step).

  python setup.py build_ext --inplace
"""

from setuptools import Extension, setup

setup(
    name="lowbit_quant_fa2_paddle_tpu",
    version="0.1.0",
    packages=[
        "lowbit_quant_fa2_paddle_tpu",
        "lowbit_quant_fa2_paddle_tpu.ops",
        "lowbit_quant_fa2_paddle_tpu.models",
        "lowbit_quant_fa2_paddle_tpu.parallel",
        "lowbit_quant_fa2_paddle_tpu.utils",
        "lowbit_quant_fa2_paddle_tpu.host",
        "lowbit_quant_fa2_paddle_tpu.evalkit",
        # The PyTorch/CUDA port. Its kernels (csrc/*.cu) are built with nvcc
        # at first use on the GPU, not here.
        "lowbit_quant_fa2_paddle_tpu_torch",
        "lowbit_quant_fa2_paddle_tpu_torch.ops",
        "lowbit_quant_fa2_paddle_tpu_torch.models",
        "lowbit_quant_fa2_paddle_tpu_torch.utils",
        "lowbit_quant_fa2_paddle_tpu_torch.host",
        "lowbit_quant_fa2_paddle_tpu_torch.parallel",
        "lowbit_quant_fa2_paddle_tpu_torch.evalkit",
        "lowbit_quant_fa2_paddle_tpu_torch.tools",
    ],
    # Bundled measured autotune defaults (utils/tuning._bundled_path) must
    # ship in built distributions, not just the repo checkout.
    package_data={
        "lowbit_quant_fa2_paddle_tpu.utils": ["tuning_defaults.json"],
        "lowbit_quant_fa2_paddle_tpu_torch.utils": ["tuning_defaults.json"],
        "lowbit_quant_fa2_paddle_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "csrc/lowbit_host.cpp"],
    },
    ext_modules=[
        Extension(
            "lowbit_quant_fa2_paddle_tpu.host._lowbit_host",
            sources=["csrc/lowbit_host.cpp"],
            extra_compile_args=["-O3", "-std=c++17", "-march=native"],
            language="c++",
        )
    ],
)

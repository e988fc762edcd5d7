"""kernels layer of the PyTorch port (see the package docstring).

Each kernel wrapper counts its launches (``softargmax_kernel.launches``,
``int8_gemm_kernel.launches``, ``bn_act_kernel.launches``). A launch
replayed from a CUDA graph runs no wrapper: :func:`add_launches` counts it
for the graph's owner.
"""


def launch_counts() -> dict:
    """Every kernel's launches so far, by kernel name."""
    from deepgraphpose_tpu_torch.ops.kernels import (bn_act_kernel,
                                                     int8_gemm_kernel,
                                                     softargmax_kernel)

    return {"softargmax_likelihood": softargmax_kernel.launches,
            **int8_gemm_kernel.launches,
            "frozen_bn_act": bn_act_kernel.launches}


def add_launches(counts: dict, times: int = 1) -> None:
    """Add ``times`` x ``counts`` (by kernel name) to the kernels' counts."""
    from deepgraphpose_tpu_torch.ops.kernels import (bn_act_kernel,
                                                     int8_gemm_kernel,
                                                     softargmax_kernel)

    for name, n in counts.items():
        if name == "softargmax_likelihood":
            softargmax_kernel.launches += times * n
        elif name == "frozen_bn_act":
            bn_act_kernel.launches += times * n
        else:
            int8_gemm_kernel.launches[name] += times * n

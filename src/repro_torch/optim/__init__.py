# The paper's classical baselines (§II), ported: Polak–Ribière conjugate
# gradient descent and the numerical-Hessian Newton method, each over a
# single-point fitness callable, counting function evaluations; and the
# LM's training optimizer: AdamW, with optional int8 error-feedback
# gradient compression.
from repro_torch.optim.adamw import AdamW, opt_state_specs  # noqa: F401
from repro_torch.optim.cgd import (CgdResult, cgd_minimize,  # noqa: F401
                                   finite_diff_gradient)
from repro_torch.optim.newton_ref import (NewtonResult,  # noqa: F401
                                          newton_minimize, numerical_gradient,
                                          numerical_hessian)
from repro_torch.optim.compression import (compress_grads,  # noqa: F401
                                           dequantize_int8,
                                           init_error_state, quantize_int8)

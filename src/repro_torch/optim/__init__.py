# The paper's classical baselines (§II), ported: Polak–Ribière conjugate
# gradient descent and the numerical-Hessian Newton method, each over a
# single-point fitness callable, counting function evaluations.
from repro_torch.optim.cgd import (CgdResult, cgd_minimize,  # noqa: F401
                                   finite_diff_gradient)
from repro_torch.optim.newton_ref import (NewtonResult,  # noqa: F401
                                          newton_minimize, numerical_gradient,
                                          numerical_hessian)

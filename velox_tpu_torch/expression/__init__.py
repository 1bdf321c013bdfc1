from velox_tpu_torch.expression.eval import (  # noqa: F401
    EvalValue, ExprSet, compile_exprs, evaluate,
)

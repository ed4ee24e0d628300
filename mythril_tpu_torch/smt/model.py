"""Satisfying assignments (reference surface: mythril/laser/smt/model.py).

A Model wraps one or more EvalEnv assignments (several when produced by the
independence solver, which solves independent constraint buckets separately
and merges the per-bucket models). `eval` returns a constant Term.
"""

from typing import List, Optional, Union

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.terms import EvalEnv, IncompleteModelError


class Model:
    """A model consisting of one or more internal assignments."""

    def __init__(self, models: Optional[List[EvalEnv]] = None):
        self.raw = models or []

    def decls(self) -> List[str]:
        """All symbol names this model assigns."""
        result: List[str] = []
        for env in self.raw:
            # bv_values holds plain-name keys plus (name, size) duplicates
            result.extend(k for k in env.bv_values.keys() if isinstance(k, str))
            result.extend(env.bool_values.keys())
            result.extend(env.arrays.keys())
        return result

    def _merged_env(self, completion: bool) -> EvalEnv:
        bv, bl, ar, fn = {}, {}, {}, {}
        for env in self.raw:
            bv.update(env.bv_values)
            bl.update(env.bool_values)
            ar.update(env.arrays)
            fn.update(env.funcs)
        return EvalEnv(bv, bl, ar, fn, completion=completion)

    def eval(
        self, expression: terms.Term, model_completion: bool = False
    ) -> Union[None, terms.Term]:
        """Evaluate the expression under this model.

        :param expression: the Term to evaluate
        :param model_completion: use default values for unassigned symbols
        :return: a constant Term, or None if the model is incomplete and
                 model_completion is False
        """
        env = self._merged_env(completion=model_completion)
        try:
            value = terms.evaluate(expression, env)
        except IncompleteModelError:
            return None
        if expression.sort == terms.BOOL:
            return terms.bool_const(bool(value))
        return terms.bv_const(int(value), expression.size)

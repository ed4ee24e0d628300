"""Base wrapper for SMT expressions: a term plus a set of annotations.

Mirrors the public surface of the reference's Expression class
(mythril/laser/smt/expression.py:11) — `.raw`, `.annotations`, `annotate`,
`simplify`, `get_annotations` — but `.raw` is our hash-consed Term, not a
z3.ExprRef. Annotation sets are how detection modules implement taint
tracking; every operation on wrapped expressions unions them.
"""

from typing import Any, Generic, Optional, Set, TypeVar

from mythril_tpu_torch.smt import terms

Annotations = Set[Any]
T = TypeVar("T")


class Expression(Generic[T]):
    """Base symbol class: simplification + annotations."""

    def __init__(self, raw: terms.Term, annotations: Optional[Annotations] = None):
        self.raw = raw
        if annotations is not None and not isinstance(annotations, set):
            annotations = set(annotations)
        self._annotations = annotations or set()

    @property
    def annotations(self) -> Annotations:
        return self._annotations

    def annotate(self, annotation: Any) -> None:
        self._annotations.add(annotation)

    def simplify(self) -> None:
        """Terms are eagerly folded at construction, so this is a no-op kept
        for API parity with the reference (which calls z3.simplify)."""

    def size(self) -> int:
        return self.raw.size

    def get_annotations(self, annotation: Any):
        return list(filter(lambda x: isinstance(x, annotation), self.annotations))

    def __repr__(self) -> str:
        return repr(self.raw)

    def __hash__(self) -> int:
        # hash-consing makes structurally-equal raws identical objects
        return hash(self.raw)


G = TypeVar("G", bound=Expression)


def simplify(expression: G) -> G:
    """Simplify the expression (in-place no-op; returns it for chaining)."""
    expression.simplify()
    return expression

"""Bit-blasting of QF_BV terms to CNF.

Lowers the theory-free term DAG (after array/UF elimination, see
preprocess.py) onto a SAT solver through a cached gate layer (structural
hashing, constant propagation — AIG style). Words are lists of literals,
LSB first. This is the host-side exact solver; the TPU batched local-search
solver (mythril_tpu_torch/laser/tpu/solver_jax.py) shares the same preprocessed
term tapes but searches for witnesses instead of proving.

The reference delegates all of this to Z3 (mythril/laser/smt/solver/solver.py);
here the full pipeline is in-repo.
"""

from typing import Dict, List, Tuple

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.terms import Term


class BlastError(Exception):
    """Raised when a term cannot be bit-blasted (should not happen after
    preprocessing)."""


class Blaster:
    def __init__(self, sat) -> None:
        self.sat = sat
        self.T = sat.new_var()  # constant-true literal
        sat.add_clause([self.T])
        self.F = -self.T
        self.gate_cache: Dict[Tuple, int] = {}
        self.word_cache: Dict[int, List[int]] = {}
        self.bool_cache: Dict[int, int] = {}
        self.div_cache: Dict[Tuple[int, int], Tuple[List[int], List[int]]] = {}
        self.var_bits: Dict[Tuple[str, int], List[int]] = {}  # (name, size)
        self.bool_vars: Dict[str, int] = {}

    # ------------------------------------------------------------------ gates

    def _new(self) -> int:
        return self.sat.new_var()

    def g_and(self, a: int, b: int) -> int:
        if a == self.F or b == self.F or a == -b:
            return self.F
        if a == self.T:
            return b
        if b == self.T:
            return a
        if a == b:
            return a
        key = ("&", a, b) if a < b else ("&", b, a)
        v = self.gate_cache.get(key)
        if v is None:
            v = self._new()
            self.sat.add_clause([-v, a])
            self.sat.add_clause([-v, b])
            self.sat.add_clause([v, -a, -b])
            self.gate_cache[key] = v
        return v

    def g_or(self, a: int, b: int) -> int:
        return -self.g_and(-a, -b)

    def g_xor(self, a: int, b: int) -> int:
        if a == self.F:
            return b
        if b == self.F:
            return a
        if a == self.T:
            return -b
        if b == self.T:
            return -a
        if a == b:
            return self.F
        if a == -b:
            return self.T
        # normalize signs out: xor(-a, b) == -xor(a, b)
        neg = (a < 0) != (b < 0)
        x, y = abs(a), abs(b)
        if x > y:
            x, y = y, x
        key = ("^", x, y)
        v = self.gate_cache.get(key)
        if v is None:
            v = self._new()
            self.sat.add_clause([-v, x, y])
            self.sat.add_clause([-v, -x, -y])
            self.sat.add_clause([v, -x, y])
            self.sat.add_clause([v, x, -y])
            self.gate_cache[key] = v
        return -v if neg else v

    def g_ite(self, c: int, t: int, e: int) -> int:
        if c == self.T:
            return t
        if c == self.F:
            return e
        if t == e:
            return t
        if t == self.T:
            return self.g_or(c, e)
        if t == self.F:
            return self.g_and(-c, e)
        if e == self.T:
            return self.g_or(-c, t)
        if e == self.F:
            return self.g_and(c, t)
        if c < 0:
            c, t, e = -c, e, t
        key = ("?", c, t, e)
        v = self.gate_cache.get(key)
        if v is None:
            v = self._new()
            self.sat.add_clause([-c, -t, v])
            self.sat.add_clause([-c, t, -v])
            self.sat.add_clause([c, -e, v])
            self.sat.add_clause([c, e, -v])
            self.gate_cache[key] = v
        return v

    def g_maj(self, a: int, b: int, c: int) -> int:
        for x, y, z in ((a, b, c), (b, c, a), (c, a, b)):
            if x == self.T:
                return self.g_or(y, z)
            if x == self.F:
                return self.g_and(y, z)
            if y == z:
                return y
            if y == -z:
                return x
        key = ("m",) + tuple(sorted((a, b, c)))
        v = self.gate_cache.get(key)
        if v is None:
            v = self._new()
            self.sat.add_clause([-a, -b, v])
            self.sat.add_clause([-a, -c, v])
            self.sat.add_clause([-b, -c, v])
            self.sat.add_clause([a, b, -v])
            self.sat.add_clause([a, c, -v])
            self.sat.add_clause([b, c, -v])
            self.gate_cache[key] = v
        return v

    def and_all(self, lits: List[int]) -> int:
        acc = self.T
        for lit in lits:
            acc = self.g_and(acc, lit)
        return acc

    def or_all(self, lits: List[int]) -> int:
        acc = self.F
        for lit in lits:
            acc = self.g_or(acc, lit)
        return acc

    # ------------------------------------------------------------- word level

    def const_word(self, value: int, size: int) -> List[int]:
        return [self.T if (value >> i) & 1 else self.F for i in range(size)]

    def w_add(self, a: List[int], b: List[int], carry_in: int = None) -> List[int]:
        c = self.F if carry_in is None else carry_in
        out = []
        for ai, bi in zip(a, b):
            axb = self.g_xor(ai, bi)
            out.append(self.g_xor(axb, c))
            c = self.g_maj(ai, bi, c)
        return out

    def w_neg(self, a: List[int]) -> List[int]:
        return self.w_add([-x for x in a], self.const_word(0, len(a)), carry_in=self.T)

    def w_sub(self, a: List[int], b: List[int]) -> List[int]:
        return self.w_add(a, [-x for x in b], carry_in=self.T)

    def w_mul(self, a: List[int], b: List[int]) -> List[int]:
        n = len(a)
        acc = self.const_word(0, n)
        for i, bi in enumerate(b):
            if bi == self.F:
                continue
            pp = [self.g_and(bi, a[j]) for j in range(n - i)]
            if all(p == self.F for p in pp):
                continue
            acc = acc[:i] + self.w_add(acc[i:], pp)
        return acc

    def w_ite(self, c: int, t: List[int], e: List[int]) -> List[int]:
        return [self.g_ite(c, ti, ei) for ti, ei in zip(t, e)]

    def w_eq(self, a: List[int], b: List[int]) -> int:
        acc = self.T
        for ai, bi in zip(a, b):
            acc = self.g_and(acc, -self.g_xor(ai, bi))
        return acc

    def w_ult(self, a: List[int], b: List[int]) -> int:
        lt = self.F
        for ai, bi in zip(a, b):  # LSB -> MSB; the most significant difference wins
            lt = self.g_ite(self.g_xor(ai, bi), bi, lt)
        return lt

    def w_slt(self, a: List[int], b: List[int]) -> int:
        a2 = a[:-1] + [-a[-1]]
        b2 = b[:-1] + [-b[-1]]
        return self.w_ult(a2, b2)

    def w_shift(self, a: List[int], sh: List[int], kind: str) -> List[int]:
        n = len(a)
        fill = a[-1] if kind == "ashr" else self.F
        stages = 0
        while (1 << stages) < n:
            stages += 1
        cur = list(a)
        for s in range(stages):
            amt = 1 << s
            if s >= len(sh):
                break
            bit = sh[s]
            if kind == "shl":
                shifted = [fill] * min(amt, n) + cur[: max(n - amt, 0)]
            else:
                shifted = cur[min(amt, n):] + [fill] * min(amt, n)
            cur = self.w_ite(bit, shifted, cur)
        # any higher bit of the shift amount set -> full shift-out
        high = self.or_all(sh[stages:])
        return self.w_ite(high, [fill] * n, cur)

    def w_udivrem(self, a: List[int], b: List[int]) -> Tuple[List[int], List[int]]:
        n = len(a)
        q = [self._new() for _ in range(n)]
        r = [self._new() for _ in range(n)]
        zero = self.const_word(0, n)
        # widen to 2n so q*b + r == a holds without wrap
        q2, b2, r2, a2 = (w + zero for w in (q, b, r, a))
        prod = self.w_mul(list(q2), list(b2))
        total = self.w_add(prod, list(r2))
        ok = self.g_and(self.w_eq(total, list(a2)), self.w_ult(r, b))
        b_is_zero = self.w_eq(b, zero)
        # SMT-LIB: bvudiv(a, 0) = all ones, bvurem(a, 0) = a
        zcase = self.g_and(self.w_eq(q, [self.T] * n), self.w_eq(r, a))
        self.sat.add_clause([self.g_ite(b_is_zero, zcase, ok)])
        return q, r

    def udivrem(self, ta: Term, tb: Term) -> Tuple[List[int], List[int]]:
        key = (ta.uid, tb.uid)
        if key not in self.div_cache:
            self.div_cache[key] = self.w_udivrem(self.word(ta), self.word(tb))
        return self.div_cache[key]

    # ----------------------------------------------------------- term lowering

    def word(self, t: Term) -> List[int]:
        got = self.word_cache.get(t.uid)
        if got is not None:
            return got
        op = t.op
        n = t.size
        if op == "const":
            w = self.const_word(t.params[0], n)
        elif op == "var":
            # keyed by (name, size): the blaster lives for the whole process
            # (incremental.py), where same-named vars of different widths are
            # distinct symbols, exactly as z3 treats name+sort
            key = (t.params[0], n)
            if key not in self.var_bits:
                self.var_bits[key] = [self._new() for _ in range(n)]
            w = self.var_bits[key]
        elif op in ("add", "sub", "mul", "and", "or", "xor"):
            a, b = self.word(t.args[0]), self.word(t.args[1])
            if op == "add":
                w = self.w_add(a, b)
            elif op == "sub":
                w = self.w_sub(a, b)
            elif op == "mul":
                w = self.w_mul(a, b)
            elif op == "and":
                w = [self.g_and(x, y) for x, y in zip(a, b)]
            elif op == "or":
                w = [self.g_or(x, y) for x, y in zip(a, b)]
            else:
                w = [self.g_xor(x, y) for x, y in zip(a, b)]
        elif op == "not":
            w = [-x for x in self.word(t.args[0])]
        elif op == "neg":
            w = self.w_neg(self.word(t.args[0]))
        elif op == "udiv":
            w = self.udivrem(t.args[0], t.args[1])[0]
        elif op == "urem":
            w = self.udivrem(t.args[0], t.args[1])[1]
        elif op in ("sdiv", "srem"):
            w = self._signed_divrem(t)
        elif op in ("shl", "lshr", "ashr"):
            w = self.w_shift(self.word(t.args[0]), self.word(t.args[1]), op)
        elif op == "concat":
            w = []
            for part in reversed(t.args):  # args are MSB-first
                w.extend(self.word(part))
        elif op == "extract":
            hi, lo = t.params
            w = self.word(t.args[0])[lo : hi + 1]
        elif op == "zext":
            w = self.word(t.args[0]) + [self.F] * t.params[0]
        elif op == "sext":
            src = self.word(t.args[0])
            w = src + [src[-1]] * t.params[0]
        elif op == "ite":
            c = self.lit(t.args[0])
            w = self.w_ite(c, self.word(t.args[1]), self.word(t.args[2]))
        elif op in ("select", "apply"):
            raise BlastError(
                "theory term '%s' reached the bit-blaster; preprocessing must "
                "eliminate arrays and uninterpreted functions first" % op
            )
        else:
            raise BlastError("cannot blast op %s" % op)
        self.word_cache[t.uid] = w
        return w

    def _signed_divrem(self, t: Term) -> List[int]:
        ta, tb = t.args
        n = t.size
        a, b = self.word(ta), self.word(tb)
        sa, sb = a[-1], b[-1]
        abs_a = self.w_ite(sa, self.w_neg(a), a)
        abs_b = self.w_ite(sb, self.w_neg(b), b)
        # cache the unsigned division on the abs terms via the term pair key
        key = ("s", ta.uid, tb.uid)
        if key not in self.div_cache:
            self.div_cache[key] = self.w_udivrem(abs_a, abs_b)
        qu, ru = self.div_cache[key]
        b_zero = self.w_eq(b, self.const_word(0, n))
        if t.op == "sdiv":
            qsign = self.g_xor(sa, sb)
            q = self.w_ite(qsign, self.w_neg(qu), qu)
            # SMT-LIB: bvsdiv(a, 0) = (a < 0) ? 1 : -1
            zcase = self.w_ite(sa, self.const_word(1, n), self.const_word(terms.mask(n), n))
            return self.w_ite(b_zero, zcase, q)
        r = self.w_ite(sa, self.w_neg(ru), ru)
        return self.w_ite(b_zero, a, r)  # bvsrem(a, 0) = a

    def lit(self, t: Term) -> int:
        got = self.bool_cache.get(t.uid)
        if got is not None:
            return got
        op = t.op
        if op == "true":
            v = self.T
        elif op == "false":
            v = self.F
        elif op == "boolvar":
            name = t.params[0]
            if name not in self.bool_vars:
                self.bool_vars[name] = self._new()
            v = self.bool_vars[name]
        elif op == "eq":
            v = self.w_eq(self.word(t.args[0]), self.word(t.args[1]))
        elif op == "ult":
            v = self.w_ult(self.word(t.args[0]), self.word(t.args[1]))
        elif op == "ule":
            v = -self.w_ult(self.word(t.args[1]), self.word(t.args[0]))
        elif op == "slt":
            v = self.w_slt(self.word(t.args[0]), self.word(t.args[1]))
        elif op == "sle":
            v = -self.w_slt(self.word(t.args[1]), self.word(t.args[0]))
        elif op == "bnot":
            v = -self.lit(t.args[0])
        elif op == "band":
            v = self.and_all([self.lit(a) for a in t.args])
        elif op == "bor":
            v = self.or_all([self.lit(a) for a in t.args])
        elif op == "iff":
            v = -self.g_xor(self.lit(t.args[0]), self.lit(t.args[1]))
        else:
            raise BlastError("cannot blast bool op %s" % op)
        self.bool_cache[t.uid] = v
        return v

    def assert_formula(self, t: Term) -> None:
        self.sat.add_clause([self.lit(t)])

    # model extraction lives in IncrementalCore.extract_env (incremental.py),
    # which bulk-reads the assignment via sat.model_copy()

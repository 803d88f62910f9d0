"""Matrix-product FLOPs of a JAX function, read from its jaxpr: the
reference's side of the port's dry-run counts (tests/test_torch_steps.py,
tests/test_torch_dryrun.py).

Every ``dot_general`` counts ``2 * batch * M * N * K`` (its batch dims,
its free dims on each side, its contracting dims); a ``scan`` body
counts its length times; the bodies of ``pjit``, ``closed_call``,
``remat`` / ``checkpoint``, ``custom_jvp_call`` and ``custom_vjp_call``
count once each time they are called; ``cond`` counts its costliest
branch.  Nothing else counts.
"""
import math


def _sub_jaxprs(eqn):
    """(multiplier, jaxpr) of each body an equation runs."""
    p = eqn.params
    name = eqn.primitive.name
    if name == "scan":
        return [(p["length"], p["jaxpr"].jaxpr)]
    if name == "cond":
        return [("max", [b.jaxpr for b in p["branches"]])]
    if name == "while":
        raise ValueError("a while loop's trip count is not in its jaxpr")
    out = []
    for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
        sub = p.get(key)
        if sub is not None:
            out.append((1, getattr(sub, "jaxpr", sub)))
    return out


def dot_flops(jaxpr) -> int:
    """Matrix-product FLOPs of a (closed) jaxpr."""
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
            ls = eqn.invars[0].aval.shape
            rs = eqn.invars[1].aval.shape
            batch = math.prod(ls[d] for d in lb)
            contract = math.prod(ls[d] for d in lc)
            m = math.prod(ls[d] for d in range(len(ls))
                          if d not in lc and d not in lb)
            n = math.prod(rs[d] for d in range(len(rs))
                          if d not in rc and d not in rb)
            total += 2 * batch * m * n * contract
            continue
        for mult, sub in _sub_jaxprs(eqn):
            if mult == "max":
                total += max(dot_flops(b) for b in sub)
            else:
                total += mult * dot_flops(sub)
    return total

#!/usr/bin/env python
"""Generate native/plant/model_indy7.inc from the embedded Python model.

Single source of truth: indy7_mpc/models/robot.py INDY7_PARAMS.  The
C++ plant and the JAX stack therefore always agree on the robot.
Run: python tools/gen_model_header.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Pure host-side codegen: stay off the accelerator (a second process on
# the card would fail for want of memory).
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from indy7_mpc.models import indy7

    m = indy7(dtype=jnp.float64)
    tr = np.asarray(m.tree_R, np.float64)
    tp = np.asarray(m.tree_p, np.float64)
    ax = np.asarray(m.axis, np.float64)
    mass = np.asarray(m.mass, np.float64)
    com = np.asarray(m.com, np.float64)
    ic = np.asarray(m.I_com, np.float64)
    grav = np.asarray(m.gravity, np.float64)
    tcp = np.asarray(m.tcp_offset, np.float64)
    qlo = np.asarray(m.q_lower, np.float64)
    qhi = np.asarray(m.q_upper, np.float64)
    vlim = np.asarray(m.velocity_limit, np.float64)

    def v3(a):
        return "{%.17g, %.17g, %.17g}" % tuple(a)

    def m3(a):
        return "{{%s, %s, %s}}" % (v3(a[0]), v3(a[1]), v3(a[2]))

    lines = [
        "// Auto-generated by tools/gen_model_header.py — do not edit.",
        "// Source: indy7_mpc/models/robot.py (description/indy7.urdf).",
        "#include \"rbd.hpp\"",
        "namespace indy7 {",
        "Model indy7_model() {",
        "  Model m;",
    ]
    for i in range(6):
        lines += [
            f"  m.tree_R[{i}] = {m3(tr[i])};",
            f"  m.tree_p[{i}] = {v3(tp[i])};",
            f"  m.axis[{i}] = {v3(ax[i])};",
            f"  m.mass[{i}] = {mass[i]:.17g};",
            f"  m.com[{i}] = {v3(com[i])};",
            f"  m.I_com[{i}] = {m3(ic[i])};",
        ]
    def vj(a):
        return "{%s}" % ", ".join("%.17g" % x for x in a)

    lines += [
        f"  m.gravity = {v3(grav)};",
        f"  m.tcp_offset = {v3(tcp)};",
        f"  m.q_lower = {vj(qlo)};",
        f"  m.q_upper = {vj(qhi)};",
        f"  m.velocity_limit = {vj(vlim)};",
        "  return m;",
        "}",
        "}  // namespace indy7",
        "",
    ]
    out = os.path.join(
        os.path.dirname(__file__), "..", "native", "plant", "model_indy7.inc"
    )
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

"""Prints the per-leaf report that
``tests/test_torch_blockwise.py::test_float32_through_kzz_inverse_no_worse_than_jax``
asserts on: for each jitter, each leaf's float32 error against the float64
step (root mean square over the test's batches), the port's beside the JAX
package's, and their ratio (the test allows 2, or both under its floor).

    python tools/float32_ratios.py

It runs the test itself, with the tests' JAX settings, and reads the
test's ``report`` as the test returns; about half a minute on the CPU.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import conftest  # noqa: E402,F401  (CPU, float64, highest matmul precision)
import test_torch_blockwise as tests  # noqa: E402

TEST = tests.test_float32_through_kzz_inverse_no_worse_than_jax


def report(jitter):
    """{leaf: (port error, JAX error)} of the test at ``jitter``, and
    whether the test passed."""
    seen = {}

    def on_return(frame, event, _arg):
        if event == "return" and frame.f_code is TEST.__code__:
            seen.update(frame.f_locals.get("report", {}))

    sys.setprofile(on_return)
    try:
        TEST(jitter)
        passed = True
    except AssertionError:
        passed = False
    finally:
        sys.setprofile(None)
    return seen, passed


def main():
    for jitter in (1e-1, 1e-2):
        leaves, passed = report(jitter)
        print(f"jitter {jitter:g} ({'passes' if passed else 'FAILS'}): leaf, port error, "
              f"JAX error, ratio")
        for name, (port, jax_err) in leaves.items():
            print(f"  {name:28s} {port:.3e} {jax_err:.3e} {port / jax_err:.3f}")


if __name__ == "__main__":
    main()

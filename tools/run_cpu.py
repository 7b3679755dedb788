#!/usr/bin/env python
"""Run a python script on the CPU backend with 8 virtual devices, whatever
accelerator the machine has.

    python tools/run_cpu.py my_script.py [args...]
"""

import os
import runpy
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")

if __name__ == "__main__":
    sys.argv = sys.argv[1:]
    sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[0])))
    runpy.run_path(sys.argv[0], run_name="__main__")

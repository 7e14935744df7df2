"""A stand-in for NVIDIA's `isaacgym` package, which neither the sandbox nor the card's machine has.

It keeps the one behaviour of the real package that an integration must respect: its dependency
check refuses to import into a process that has already imported torch. The simulation itself is
in the stand-in `isaacgymenvs.tasks`.
"""

import sys

if "torch" in sys.modules:
    raise ImportError("PyTorch was imported before isaacgym modules.  Please import torch after isaacgym modules.")

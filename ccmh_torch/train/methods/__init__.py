"""Method registry (port of ``ccmh/train/methods/__init__.py``).

``ccmh`` registers all 14 reference methods (main.py:18-33), and so does
the port: :data:`PORTED` lists the modules, each defining ``METHOD``.  An
unknown name raises ``KeyError`` instead of falling back to anything.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from ccmh_torch.train.methods.base import Method

# module name -> method name (reference main.py:18-33), as in ccmh
EXPECTED_METHODS: Dict[str, str] = {
    "dchmt": "DCHMT",
    "dsph": "DSPH",
    "dnph_tmm": "DNpH",
    "dhaph": "DHaPH",
    "dmsh_ln": "DMsH_LN",
    "dscph": "DScPH",
    "ddwsh": "DDWSH",
    "ddbh": "DDBH",
    "dnph_tomm": "DNPH",
    "twdh": "TwDH",
    "dpbe": "DPBE",
    "mith": "MITH",
    "dpsih": "DPSIH",
    "dghdgh": "DGHDGH",
}

# modules of ccmh_torch.train.methods ported (all 14); each defines METHOD
PORTED = tuple(EXPECTED_METHODS)


def available_methods() -> List[str]:
    """Names of the methods ported to ccmh_torch."""
    return sorted(EXPECTED_METHODS[m] for m in PORTED)


def unported_methods() -> List[str]:
    """Names of the reference methods not ported yet."""
    return sorted(n for m, n in EXPECTED_METHODS.items() if m not in PORTED)


def get_method(name: str) -> Method:
    for mod in PORTED:
        if EXPECTED_METHODS[mod] == name:
            return importlib.import_module(f"ccmh_torch.train.methods.{mod}").METHOD
    raise KeyError(f"unknown method {name!r}; ported: {available_methods()}")

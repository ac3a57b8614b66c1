"""Method registry (port of ``ccmh/train/methods/__init__.py``).

``ccmh`` registers all 14 reference methods (main.py:18-33).  The port
lists the methods ported so far in :data:`PORTED`; asking for one of the
others raises ``NotImplementedError`` that names what is and is not ported,
instead of falling back to anything.
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

# modules of ccmh_torch.train.methods ported so far; each defines METHOD
PORTED = ("dchmt", "dsph", "dnph_tmm", "dhaph", "dmsh_ln", "dscph", "ddwsh", "ddbh", "mith",
          "dpsih")


def available_methods() -> List[str]:
    """Names of the methods ported to ccmh_torch."""
    return sorted(EXPECTED_METHODS[m] for m in PORTED)


def unported_methods() -> List[str]:
    """Names of the reference methods not ported yet."""
    return sorted(n for m, n in EXPECTED_METHODS.items() if m not in PORTED)


def get_method(name: str) -> Method:
    for mod, method_name in EXPECTED_METHODS.items():
        if method_name != name:
            continue
        if mod not in PORTED:
            raise NotImplementedError(
                f"method {name!r} is not ported to ccmh_torch yet; ported: "
                f"{available_methods()}, not yet ported: {unported_methods()}")
        return importlib.import_module(f"ccmh_torch.train.methods.{mod}").METHOD
    raise KeyError(f"unknown method {name!r}; ported: {available_methods()}")

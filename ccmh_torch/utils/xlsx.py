"""Minimal stdlib xlsx reader (copy of ``ccmh/utils/xlsx.py``; the card's
machine has neither xlrd nor openpyxl).

Just enough to read DSPH's threshold code table (reference:
train/DSPH/loss.py:16-20 reads row=output_dim, col=ceil(log2(numclass))
from codetable.xlsx via xlrd).
"""

from __future__ import annotations

import re
import zipfile
from typing import Dict, List, Optional
from xml.etree import ElementTree

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}


def _col_to_index(ref: str) -> int:
    """'A1' -> 0, 'AB3' -> 27."""
    letters = re.match(r"[A-Z]+", ref).group(0)
    idx = 0
    for ch in letters:
        idx = idx * 26 + (ord(ch) - ord("A") + 1)
    return idx - 1


def read_sheet(path: str, sheet_index: int = 0) -> List[List[Optional[float]]]:
    """Return the first worksheet as a dense list-of-rows of floats/strings."""
    with zipfile.ZipFile(path) as zf:
        shared: List[str] = []
        try:
            root = ElementTree.fromstring(zf.read("xl/sharedStrings.xml"))
            for si in root.findall("m:si", _NS):
                shared.append("".join(t.text or "" for t in si.iter(f"{{{_NS['m']}}}t")))
        except KeyError:
            pass

        sheet_name = f"xl/worksheets/sheet{sheet_index + 1}.xml"
        root = ElementTree.fromstring(zf.read(sheet_name))
        rows: Dict[int, Dict[int, Optional[float]]] = {}
        max_col = 0
        for row_el in root.iter(f"{{{_NS['m']}}}row"):
            r = int(row_el.get("r")) - 1
            cells: Dict[int, Optional[float]] = {}
            for c_el in row_el.findall("m:c", _NS):
                c = _col_to_index(c_el.get("r"))
                v_el = c_el.find("m:v", _NS)
                if v_el is None or v_el.text is None:
                    continue
                if c_el.get("t") == "s":
                    val: Optional[float] = shared[int(v_el.text)]  # type: ignore[assignment]
                else:
                    try:
                        val = float(v_el.text)
                    except ValueError:
                        val = v_el.text  # type: ignore[assignment]
                cells[c] = val
                max_col = max(max_col, c)
            rows[r] = cells

    n_rows = max(rows) + 1 if rows else 0
    dense: List[List[Optional[float]]] = []
    for r in range(n_rows):
        row = rows.get(r, {})
        dense.append([row.get(c) for c in range(max_col + 1)])
    return dense


def read_cell(path: str, row: int, col: int) -> Optional[float]:
    sheet = read_sheet(path)
    try:
        return sheet[row][col]
    except IndexError:
        return None

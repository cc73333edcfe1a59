"""TIPS 2017 web API client (counterpart of pylbl_tpu/webapi/tips_api.py).

Streams and parses the fixed-format ASCII supplementary tables (same
source and record grammar as the reference, reference
pyLBL/webapi/tips_api.py:9-124).  The block and record parsing works on
any binary file-like object, so it is testable offline.
"""
from re import match
from urllib.request import urlopen

import numpy as np


class NoMoleculeError(BaseException):
    """No TIPS data found for this molecule."""
    pass


class TipsWebApi:
    """Access to the TIPS 2017 tables.

    Attributes:
        url: source URL of the ASCII table.
    """

    # Table grammar: comment lines start with "c"; a bare formula on its
    # own line heads each molecule block; a "T / K  Q  Q ..." header gives
    # the isotopologue count; numeric rows follow until the next heading.
    _HEADING = r"\s*[A-Za-z0-9+]+$"
    _COLUMN_HEADER = r"\s*T / K"

    def __init__(self):
        self.url = ("http://faculty.uml.edu/Robert_Gamache/"
                    "Software/temp/Supplementary_file.txt")

    def download(self, molecule):
        """Downloads and parses the table for one molecule.

        Returns:
            (temperature[nT], data[nIso, nT]) float32 arrays (the reference
            parses with float32, tips_api.py:86-88).
        """
        return self._parse_records(self._records(urlopen(self.url),
                                                 molecule))

    @staticmethod
    def _ascii_table_records(response, block_size=512):
        """Yields complete lines from a block-buffered binary response.

        The role of reference tips_api.py:31-68, with the carry-over of a
        partial line across block boundaries kept in every case (the
        reference drops the carried prefix when a block holds no newline,
        or when a carried line completes a single-line block).
        """
        carry = ""
        while True:
            block = response.read(block_size).decode("utf-8")
            if not block:
                yield carry
                return
            *complete, tail = (carry + block).split("\n")
            yield from complete
            carry = tail   # the incomplete tail ("" after a newline).
            if len(block) != block_size:
                yield carry
                return

    @staticmethod
    def _parse_records(records):
        rows = [record for record in records if record]
        temperature = np.asarray([row[0] for row in rows], dtype=np.float32)
        data = np.transpose(np.asarray([row[1:] for row in rows],
                                       dtype=np.float32))
        return temperature, data

    def _records(self, response, molecule):
        """Yields per-temperature [T, Q1..Qn] rows of one molecule's block
        (the grammar of reference tips_api.py:90-119, as seek, header and
        body stages over one line iterator).

        Raises:
            NoMoleculeError: molecule heading not found.
        """
        lines = iter(self._ascii_table_records(response))

        heading = rf"\s*{molecule}$"
        for line in lines:
            if not line.startswith("c") and match(heading, line):
                break
        else:
            raise NoMoleculeError(
                f"molecule {molecule} not found in TIPS 2017 tables.")

        num_columns = 0
        for line in lines:
            if match(self._HEADING, line):
                return
            if match(self._COLUMN_HEADER, line):
                num_columns = 1 + line.count("Q")
                break

        for line in lines:
            if match(self._HEADING, line):
                return
            yield [np.float32(cell) for cell in line.split()[:num_columns]]

"""The benchmark's own tests: run from the repository's root with
``python -m pytest benchmark/tests -q``; the tests marked ``cuda`` skip
where there is no card."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

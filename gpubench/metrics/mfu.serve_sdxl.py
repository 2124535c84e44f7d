"""Model FLOPs of the faces restored in the window over the window's wall
seconds times the cards' bf16 peak, in %, counted on the SDXL reference's
shapes (``gpubench/flops_sdxl.py``): ``mfu.serve``'s definition, read by
that file's reader, loaded here."""

import importlib.util
from pathlib import Path

_path = Path(__file__).with_name("mfu.serve.py")
_spec = importlib.util.spec_from_file_location(f"gpubench_metric_{_path.stem}", _path)
_reader = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_reader)
read = _reader.read

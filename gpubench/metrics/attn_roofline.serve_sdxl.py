"""The attention calls' least time over the device time of the kernels of
every ``attention`` family, in %, over the SDXL reference's attention calls
(``gpubench/flops_sdxl.py``): ``attn_roofline.serve``'s definition, read by
that file's reader, loaded here."""

import importlib.util
from pathlib import Path

_path = Path(__file__).with_name("attn_roofline.serve.py")
_spec = importlib.util.spec_from_file_location(f"gpubench_metric_{_path.stem}", _path)
_reader = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_reader)
read = _reader.read

"""Device ms a face of the program's ``unet`` stage (the restoration SDXL
UNet) over the profiled batches: ``unet_ms_per_face.serve``'s definition,
read by that file's reader, loaded here."""

import importlib.util
from pathlib import Path

_path = Path(__file__).with_name("unet_ms_per_face.serve.py")
_spec = importlib.util.spec_from_file_location(f"gpubench_metric_{_path.stem}", _path)
_reader = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_reader)
read = _reader.read

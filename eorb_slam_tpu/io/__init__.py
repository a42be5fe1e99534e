"""I/O layer: config system, dataset loaders, trajectory serialization.

Re-expression of the reference's L8 (reference
src/Utils/DataStore.cpp, src/Event/EventLoader.cpp, src/Utils/MyParameters.cpp,
src/Utils/MyYamlParser.cpp): one YAML settings file drives everything; loaders
serve fixed-shape tensor chunks ready for jitted kernels instead of per-item
C++ objects.
"""

from eorb_slam_tpu.io import config, datasets, trajectory  # noqa: F401

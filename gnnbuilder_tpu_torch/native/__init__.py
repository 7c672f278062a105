"""Native (C++) host-side helpers: the batch packer (``packing.cpp``),
compiled with g++ at first use into the build directory
(``native/build.py``) and loaded via ctypes (``native/lib.py``)."""

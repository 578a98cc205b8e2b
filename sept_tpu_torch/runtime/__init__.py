"""Native IO of the port: the WAV decoder (``csrc/septio.cpp``) via ctypes."""

"""Volume I/O: NIfTI (numpy, and a native decoder) and DICOM."""

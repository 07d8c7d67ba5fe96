"""Device plane of the PyTorch port: torch expression lowering, the
bridge to the device, the stage compiler and the CUDA kernels
(``cuda/``).  Importing it loads torch only; kernels build at first use."""

"""The sweep kernel (CUDA, built at first use), its plain version and the
search backend around it."""

"""File input and output: OBJ meshes (``obj``) and images (``image``);
timing and ``torch.profiler`` traces (``profiling``)."""

"""File input and output: OBJ meshes (``obj``) and images (``image``)."""

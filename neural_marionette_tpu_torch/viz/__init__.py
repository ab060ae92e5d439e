"""Renders of the port, on the card: the demos' rasterizer
(``raster``), the voxel/keypoint GIF videos (``visualize``) and the PNG and
GIF files (``image_files``)."""

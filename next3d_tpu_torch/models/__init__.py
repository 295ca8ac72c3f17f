from .osg_decoder import OSGDecoder
from .triplane_next3d import TriPlaneGenerator, build_generator
from .triplane_texture import TriPlaneTextureGenerator, build_texture_generator
from .triplane_eg3d import EG3DTriPlaneGenerator, build_eg3d_generator

from .stylegan2 import (
    FullyConnected,
    Conv2d,
    MappingNetwork,
    SynthesisLayer,
    ToRGBLayer,
    SynthesisBlock,
    SynthesisNetwork,
    Generator,
    modulated_conv2d,
    normalize_2nd_moment,
)
from .styleunet import EncoderResBlock, CondSynthesisNetwork, CondGenerator
from .superresolution import (
    SuperresolutionHybrid2X,
    SuperresolutionHybrid8XDC,
)
from .discriminator import (
    DiscriminatorBlock,
    DiscriminatorEpilogue,
    Discriminator,
    DualDiscriminator,
    filtered_resizing,
    minibatch_std,
)

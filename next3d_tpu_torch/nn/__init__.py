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
from .stylegan3 import (
    SG3Generator,
    SG3MappingNetwork,
    SG3SynthesisLayer,
    SG3SynthesisNetwork,
    SynthesisInput,
    design_lowpass_filter,
    modulated_conv2d_sg3,
)
from .styleunet import EncoderResBlock, CondSynthesisNetwork, CondGenerator
from .superresolution import (
    SynthesisBlockNoUp,
    SuperresolutionHybrid2X,
    SuperresolutionHybrid4X,
    SuperresolutionHybrid8X,
    SuperresolutionHybrid8XDC,
    SuperresolutionHybridDeepfp32,
)
from .discriminator import (
    DiscriminatorBlock,
    DiscriminatorEpilogue,
    Discriminator,
    DualDiscriminator,
    filtered_resizing,
    minibatch_std,
)

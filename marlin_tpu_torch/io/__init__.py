"""IO: Marlin's text formats, the MarlinChunk data plane, MNIST idx files,
checkpoints (counterpart of ``marlin_tpu/io``)."""

from .text import (  # noqa: F401
    load_matrix_file,
    load_matrix_files,
    load_matrix_file_out_of_core,
    iter_matrix_file_chunks,
    load_block_matrix_file,
    load_block_matrix_files,
    load_coordinate_matrix,
    load_svm_den_vec_matrix,
    save_matrix,
)
from .mnist import (  # noqa: F401
    iter_mnist_image_chunks,
    mnist_images_out_of_core,
)
from .chunkstore import (  # noqa: F401
    ChunkStore,
    ChunkStoreWriter,
    ChunkstoreError,
    ChunkstoreCorruptError,
    write_chunkstore,
    transcode_text,
    transcode_idx,
    sidecar_path,
    open_sidecar,
)
from .checkpoint import (  # noqa: F401
    save_checkpoint,
    load_checkpoint,
    save_sharded,
    load_sharded,
    CheckpointCorruptError,
    list_generations,
    prune_generations,
    verify_generation,
)
from .fs import register_filesystem  # noqa: F401
from .orbax_ckpt import OrbaxCheckpointer  # noqa: F401

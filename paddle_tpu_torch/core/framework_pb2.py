# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: paddle_tpu/core/framework.proto
"""Generated protocol buffer code: the ProgramDesc messages of
paddle_tpu/core/framework.proto.

The serialized descriptor is byte for byte the JAX package's (the same
file name and proto package), so both packages load into one process
(the default pool accepts the identical file twice) and share one wire
format.  Imported only by the proto functions of core/serialization.py:
nothing else in the port needs google.protobuf."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1fpaddle_tpu/core/framework.proto\x12\x14paddle_tpu.framework\"\x16\n\x07IntList\x12\x0b\n\x03val\x18\x01 \x03(\x03\"\x18\n\tFloatList\x12\x0b\n\x03val\x18\x01 \x03(\x01\"\x19\n\nStringList\x12\x0b\n\x03val\x18\x01 \x03(\t\"\x17\n\x08\x42oolList\x12\x0b\n\x03val\x18\x01 \x03(\x08\"\xae\x02\n\tAttribute\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0b\n\x01i\x18\x02 \x01(\x03H\x00\x12\x0b\n\x01\x66\x18\x03 \x01(\x01H\x00\x12\x0b\n\x01s\x18\x04 \x01(\tH\x00\x12\x0b\n\x01\x62\x18\x05 \x01(\x08H\x00\x12-\n\x04ints\x18\x06 \x01(\x0b\x32\x1d.paddle_tpu.framework.IntListH\x00\x12\x31\n\x06\x66loats\x18\x07 \x01(\x0b\x32\x1f.paddle_tpu.framework.FloatListH\x00\x12\x33\n\x07strings\x18\x08 \x01(\x0b\x32 .paddle_tpu.framework.StringListH\x00\x12/\n\x05\x62ools\x18\t \x01(\x0b\x32\x1e.paddle_tpu.framework.BoolListH\x00\x12\x0e\n\x04json\x18\n \x01(\x0cH\x00\x42\x07\n\x05value\"\x1c\n\x0bVarNameList\x12\r\n\x05names\x18\x01 \x03(\t\"\x85\x03\n\x07VarDesc\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\thas_shape\x18\x02 \x01(\x08\x12\r\n\x05shape\x18\x03 \x03(\x03\x12\r\n\x05\x64type\x18\x04 \x01(\t\x12\x13\n\x0bpersistable\x18\x05 \x01(\x08\x12\x15\n\rstop_gradient\x18\x06 \x01(\x08\x12\x14\n\x0cis_parameter\x18\x07 \x01(\x08\x12\x11\n\ttrainable\x18\x08 \x01(\x08\x12\x11\n\tlod_level\x18\t \x01(\x05\x12\x0f\n\x07is_data\x18\n \x01(\x08\x12\x18\n\x10initializer_json\x18\x0b \x01(\x0c\x12\x33\n\x04type\x18\x0c \x01(\x0e\x32%.paddle_tpu.framework.VarDesc.VarType\x12\x12\n\nshard_axis\x18\r \x01(\t\x12\x11\n\tshard_dim\x18\x0e \x01(\x05\x12\x10\n\x08\x61\x63\x63um_of\x18\x0f \x01(\t\":\n\x07VarType\x12\x10\n\x0c\x44\x45NSE_TENSOR\x10\x00\x12\x11\n\rSELECTED_ROWS\x10\x01\x12\n\n\x06READER\x10\x02\"\xe1\x02\n\x06OpDesc\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x38\n\x06inputs\x18\x02 \x03(\x0b\x32(.paddle_tpu.framework.OpDesc.InputsEntry\x12:\n\x07outputs\x18\x03 \x03(\x0b\x32).paddle_tpu.framework.OpDesc.OutputsEntry\x12.\n\x05\x61ttrs\x18\x04 \x03(\x0b\x32\x1f.paddle_tpu.framework.Attribute\x1aP\n\x0bInputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x30\n\x05value\x18\x02 \x01(\x0b\x32!.paddle_tpu.framework.VarNameList:\x02\x38\x01\x1aQ\n\x0cOutputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x30\n\x05value\x18\x02 \x01(\x0b\x32!.paddle_tpu.framework.VarNameList:\x02\x38\x01\"\x84\x01\n\tBlockDesc\x12\x0b\n\x03idx\x18\x01 \x01(\x05\x12\x12\n\nparent_idx\x18\x02 \x01(\x05\x12+\n\x04vars\x18\x03 \x03(\x0b\x32\x1d.paddle_tpu.framework.VarDesc\x12)\n\x03ops\x18\x04 \x03(\x0b\x32\x1c.paddle_tpu.framework.OpDesc\"\xed\x01\n\x0bProgramDesc\x12\x0f\n\x07version\x18\x01 \x01(\x03\x12\x13\n\x0brandom_seed\x18\x02 \x01(\x03\x12/\n\x06\x62locks\x18\x03 \x03(\x0b\x32\x1f.paddle_tpu.framework.BlockDesc\x12\x46\n\x0bop_versions\x18\x04 \x03(\x0b\x32\x31.paddle_tpu.framework.ProgramDesc.OpVersionsEntry\x12\x0c\n\x04role\x18\x05 \x01(\t\x1a\x31\n\x0fOpVersionsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03:\x02\x38\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'paddle_tpu_torch.core.framework_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _OPDESC_INPUTSENTRY._options = None
  _OPDESC_INPUTSENTRY._serialized_options = b'8\001'
  _OPDESC_OUTPUTSENTRY._options = None
  _OPDESC_OUTPUTSENTRY._serialized_options = b'8\001'
  _PROGRAMDESC_OPVERSIONSENTRY._options = None
  _PROGRAMDESC_OPVERSIONSENTRY._serialized_options = b'8\001'
  _INTLIST._serialized_start=57
  _INTLIST._serialized_end=79
  _FLOATLIST._serialized_start=81
  _FLOATLIST._serialized_end=105
  _STRINGLIST._serialized_start=107
  _STRINGLIST._serialized_end=132
  _BOOLLIST._serialized_start=134
  _BOOLLIST._serialized_end=157
  _ATTRIBUTE._serialized_start=160
  _ATTRIBUTE._serialized_end=462
  _VARNAMELIST._serialized_start=464
  _VARNAMELIST._serialized_end=492
  _VARDESC._serialized_start=495
  _VARDESC._serialized_end=884
  _VARDESC_VARTYPE._serialized_start=826
  _VARDESC_VARTYPE._serialized_end=884
  _OPDESC._serialized_start=887
  _OPDESC._serialized_end=1240
  _OPDESC_INPUTSENTRY._serialized_start=1077
  _OPDESC_INPUTSENTRY._serialized_end=1157
  _OPDESC_OUTPUTSENTRY._serialized_start=1159
  _OPDESC_OUTPUTSENTRY._serialized_end=1240
  _BLOCKDESC._serialized_start=1243
  _BLOCKDESC._serialized_end=1375
  _PROGRAMDESC._serialized_start=1378
  _PROGRAMDESC._serialized_end=1615
  _PROGRAMDESC_OPVERSIONSENTRY._serialized_start=1566
  _PROGRAMDESC_OPVERSIONSENTRY._serialized_end=1615
# @@protoc_insertion_point(module_scope)
